"""The inputs of the cells that ``traffic.build`` made before its trace
generators and draws were found by name are bitwise what they were: each
tensor of ``GridInputs`` at the tiny size, by sha256, against the digests
taken on the tree of commit 6e897ea6226af1ed3abcde7162878c38c29a6848."""

import hashlib

import pytest

from portbench import traffic
from portbench.cpu_cells import tiny

#: (rule, seed) -> tensor -> (sha256 of its bytes, dtype, shape); and the round budget
PARENT = {
    ("megha", 2**31 + 5): {
        "job": ("06f72541b94143cc55ce2b9a0d2879760988124390f55134b0f1c6f3e1622328",
                "torch.int32", (1152,)),
        "duration": ("9f78f24adae012dd2951bb3dc4245a90fce64b9ca0a25ed08285b3188bbcfab7",
                     "torch.float32", (1152,)),
        "job_ntasks": ("ef79d99f724bf636875b1c74efcaf06e0dbb750e48aca7bedf516a93cc544e6c",
                       "torch.int32", (12,)),
        "submit": ("a0349f09f2ba4f3b756a9b017c5a311557a233273b18977ba03970abf2f97c89",
                   "torch.float32", (2, 1152)),
        "job_submit": ("079b596c5856ea3826de8f3ce1e8ed37a0b4e1891fd6d3f8ab1ec3bfafda0974",
                       "torch.float32", (2, 12)),
        "draws.orders": ("10435f663ae1dfb8f5fb620553756eeccb48e37e0889d7c4f401aca6841a43a0",
                         "torch.int32", (2, 8, 640)),
        "num_rounds": 339,
    },
    ("megha", 7): {
        "job": ("06f72541b94143cc55ce2b9a0d2879760988124390f55134b0f1c6f3e1622328",
                "torch.int32", (1152,)),
        "duration": ("9f78f24adae012dd2951bb3dc4245a90fce64b9ca0a25ed08285b3188bbcfab7",
                     "torch.float32", (1152,)),
        "job_ntasks": ("ef79d99f724bf636875b1c74efcaf06e0dbb750e48aca7bedf516a93cc544e6c",
                       "torch.int32", (12,)),
        "submit": ("1d1179fcd2458a4159edf8312fb7747257eb41f7002685ebe65032da8cec343b",
                   "torch.float32", (2, 1152)),
        "job_submit": ("1b8d2f2cef4ef80d26f1d8f15f0d84d38115ce50a2f6b44c711062c04f03d338",
                       "torch.float32", (2, 12)),
        "draws.orders": ("3e276e389af3d337113c862098bef84af4fda8f07bb63421ea0deddc8dd69547",
                         "torch.int32", (2, 8, 640)),
        "num_rounds": 339,
    },
    ("sparrow", 2**31 + 5): {
        "job": ("06f72541b94143cc55ce2b9a0d2879760988124390f55134b0f1c6f3e1622328",
                "torch.int32", (1152,)),
        "duration": ("9f78f24adae012dd2951bb3dc4245a90fce64b9ca0a25ed08285b3188bbcfab7",
                     "torch.float32", (1152,)),
        "job_ntasks": ("ef79d99f724bf636875b1c74efcaf06e0dbb750e48aca7bedf516a93cc544e6c",
                       "torch.int32", (12,)),
        "submit": ("a0349f09f2ba4f3b756a9b017c5a311557a233273b18977ba03970abf2f97c89",
                   "torch.float32", (2, 1152)),
        "job_submit": ("079b596c5856ea3826de8f3ce1e8ed37a0b4e1891fd6d3f8ab1ec3bfafda0974",
                       "torch.float32", (2, 12)),
        "draws.targets": ("f07eaf949144e48b3b3c6d8dce2009a45dff5b8ae527b54d37c4c262548124a5",
                          "torch.int32", (2, 12, 192)),
        "num_rounds": 339,
    },
    ("sparrow", 7): {
        "job": ("06f72541b94143cc55ce2b9a0d2879760988124390f55134b0f1c6f3e1622328",
                "torch.int32", (1152,)),
        "duration": ("9f78f24adae012dd2951bb3dc4245a90fce64b9ca0a25ed08285b3188bbcfab7",
                     "torch.float32", (1152,)),
        "job_ntasks": ("ef79d99f724bf636875b1c74efcaf06e0dbb750e48aca7bedf516a93cc544e6c",
                       "torch.int32", (12,)),
        "submit": ("1d1179fcd2458a4159edf8312fb7747257eb41f7002685ebe65032da8cec343b",
                   "torch.float32", (2, 1152)),
        "job_submit": ("1b8d2f2cef4ef80d26f1d8f15f0d84d38115ce50a2f6b44c711062c04f03d338",
                       "torch.float32", (2, 12)),
        "draws.targets": ("35dd88748b6df6b997748b3a9b6ca7474ed6963336909feef43eac3cd11312b9",
                          "torch.int32", (2, 12, 192)),
        "num_rounds": 339,
    },
}


def digests(inp: traffic.GridInputs) -> dict:
    tensors = dict(job=inp.job, duration=inp.duration, job_ntasks=inp.job_ntasks,
                   submit=inp.submit, job_submit=inp.job_submit,
                   **{f"draws.{k}": v for k, v in inp.draws.items()})
    out = {k: (hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest(), str(t.dtype),
               tuple(t.shape)) for k, t in tensors.items()}
    out["num_rounds"] = inp.num_rounds
    return out


@pytest.mark.parametrize("rule, seed", list(PARENT))
def test_inputs_are_bitwise_the_parents(rule, seed):
    cell = tiny(rule)
    inp = traffic.build(cell.cfg, cell.traffic, seed, "cpu")
    assert digests(inp) == PARENT[rule, seed]
    assert inp.seeds == (seed, seed + 1)
