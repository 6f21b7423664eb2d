"""borrow_kept_share: share (%) of the batched borrow pass's point-work that
a point keeps, over the profiled stretch: Σ ``megha.borrow_points`` (the
points that needed the pass, a ``bool[B]`` counted in each round that ran
it) over B x ``megha.borrow_rounds`` (every point works in each such round),
from the program's counters.  Nothing to read where no round borrowed."""

from portbench.program_spans import record


def read(ctx):
    rec = record(ctx)
    if rec is None or not rec.counters.get("megha.borrow_rounds"):
        return None
    # the counter's items: B points in each of the borrow rounds
    return 100.0 * rec.counters["megha.borrow_points"] / rec.counter_items["megha.borrow_points"]
