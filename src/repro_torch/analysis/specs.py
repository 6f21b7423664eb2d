"""Declarative shape/dtype specs for the simx state dataclasses (port of
``repro/analysis/specs.py``, over torch tensors).

Every tensor field of the port's simx dataclasses (the ``CoreState``
family, ``TaskArrays``, ``FaultSchedule``, ``Provenance``, the stream
layouts, the telemetry sketch) carries its contract in the field metadata
(``state.spec("int32[W, R]")``), the same strings as the reference's.
This module reads them:

  * ``parse_spec`` / ``field_specs`` expose the contract; ``missing_specs``
    lists tensor-annotated fields without one (``speccheck``'s coverage).
  * ``check_state(state, dims)`` validates a live state: exact dtype, and
    shapes resolved against a symbol table (``{"W": 32, "G": 2}``) whose
    unknown symbols bind on first use and must then agree everywhere.
    Nested spec'd dataclasses (``EagleLayout.probes``) are checked with the
    same table.

**Weak types.**  The reference also rejects JAX's weak-typed arrays: a
``x + 1.0`` on an int32 field gives a weak float32, the right value with
the wrong type, one recompile per call.  torch has no weak types: the same
``x + 1.0`` turns an int32 tensor into a plain float32 one, which the dtype
check already catches.  So there is no weak-type check and no
``allow_weak`` argument.

**Leading axes.**  The spec strings name one point's shapes.  The port's
batched states carry a leading point axis B on every field, and a
lane-stacked stream (``shard.sharded_steady_state``) a lane axis on every
state, window and layout field.  ``check_state(..., lead=("B",))`` strips
those axes first and binds each to its own symbol, which must agree across
fields like any other.  Name the lane axis ``"lanes"``: the spec symbol
``L`` already means ``num_lms`` (``dims_for``), which the lane count need
not equal.

Spec grammar (one line per field)::

    spec   := dtype "[" dims? "]"
    dtype  := "int32" | "float32" | "bool" | "int64" | "float64" | ...
    dims   := dim ("," dim)*
    dim    := SYMBOL | INTEGER | "?"          # "?" matches any size

``"float32[]"`` is a scalar; ``"int32[G, ?]"`` fixes the row count and
leaves the padded width free.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Any, Optional

import torch

#: metadata key carrying the spec string on a dataclass field
SPEC_KEY = "spec"

_SPEC_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*\[([^\]]*)\]\s*$")
_DIM_RE = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*|\d+|\?)$")

#: torch dtypes by the spec grammar's names: ``str(torch.int32)`` is
#: ``"torch.int32"``, so the names are mapped here, not derived
DTYPE_NAMES = {
    torch.bool: "bool",
    torch.uint8: "uint8",
    torch.int8: "int8",
    torch.int16: "int16",
    torch.int32: "int32",
    torch.int64: "int64",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.float32: "float32",
    torch.float64: "float64",
}


class SpecError(ValueError):
    """A state violated its declared shape/dtype contract."""


@dataclass(frozen=True)
class Spec:
    """One parsed field contract: dtype name + symbolic dims."""

    dtype: str
    dims: tuple  # of str symbols, int literals, or "?" wildcards
    text: str    # the original spec string, for messages

    def __str__(self) -> str:
        return self.text


def parse_spec(text: str) -> Spec:
    """Parse an ``"int32[W, R]"``-style spec string."""
    m = _SPEC_RE.match(text)
    if not m:
        raise SpecError(
            f"malformed spec {text!r}: expected dtype[dim, ...] "
            "(e.g. 'int32[W, R]', 'float32[]')"
        )
    dtype, body = m.group(1), m.group(2).strip()
    dims: list = []
    if body:
        for raw in body.split(","):
            d = raw.strip()
            if not _DIM_RE.match(d):
                raise SpecError(f"malformed dim {d!r} in spec {text!r}")
            dims.append(int(d) if d.isdigit() else d)
    return Spec(dtype=dtype, dims=tuple(dims), text=text)


def field_specs(cls) -> dict[str, Spec]:
    """name -> parsed Spec for every spec-carrying field of ``cls``
    (inherited fields included, declaration order preserved)."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a dataclass")
    out: dict[str, Spec] = {}
    for f in dataclasses.fields(cls):
        text = f.metadata.get(SPEC_KEY)
        if text is not None:
            out[f.name] = parse_spec(text)
    return out


def _is_tensor_annotation(f: dataclasses.Field) -> bool:
    """Does this field's annotation declare a tensor?  Annotations are
    strings under ``from __future__ import annotations``."""
    t = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", "")
    return "torch.Tensor" in t or t == "Tensor"


def missing_specs(cls) -> list[str]:
    """Tensor-annotated fields of ``cls`` with no spec in their metadata:
    the coverage gaps ``speccheck`` fails on."""
    return [
        f.name
        for f in dataclasses.fields(cls)
        if _is_tensor_annotation(f) and SPEC_KEY not in f.metadata
    ]


def dtype_name(dtype: torch.dtype) -> str:
    """The spec grammar's name of a torch dtype (``torch.int32`` ->
    ``"int32"``)."""
    try:
        return DTYPE_NAMES[dtype]
    except KeyError:
        raise SpecError(f"dtype {dtype} has no name in the spec grammar") from None


def _leaf_info(value) -> tuple[str, tuple]:
    """(dtype name, shape) of a tensor leaf; raises on anything else."""
    if not isinstance(value, torch.Tensor):
        raise SpecError(f"expected a tensor, got {type(value).__name__}")
    return dtype_name(value.dtype), tuple(value.shape)


def check_state(
    obj: Any,
    dims: Optional[dict] = None,
    *,
    where: str = "",
    lead: tuple = (),
) -> dict:
    """Validate ``obj`` (a spec-carrying dataclass instance) against its
    declared field specs.

    ``dims`` maps dim symbols to sizes (``{"W": 32, "T": 100}``); symbols
    not present bind from the first field that uses them and must agree
    everywhere after (so callers only pin the dims they care about).
    ``lead`` names leading axes every tensor field carries beyond its spec
    (``("B",)`` for a batched state, ``("lanes",)`` for a lane-stacked
    stream): they are stripped before the spec applies and bind like any
    other symbol.  Returns the resolved symbol table.  Raises ``SpecError``
    listing EVERY violation: dtype drift, shape mismatches, missing leading
    axes and inconsistent symbol bindings.

    Fields whose value is itself a spec-carrying dataclass (nested layouts)
    are validated recursively against the same table and leading axes;
    fields without a spec (static capacities, dicts of series) are
    skipped."""
    resolved = dict(dims or {})
    errors: list[str] = []
    _check_into(obj, resolved, where or type(obj).__name__, errors, tuple(lead))
    if errors:
        raise SpecError(
            f"{len(errors)} spec violation(s):\n  " + "\n  ".join(errors)
        )
    return resolved


def _bind(sym, actual: int, resolved: dict, label: str, spec, errors: list) -> None:
    """Match one axis of size ``actual`` against a dim symbol or literal."""
    if sym == "?":
        return
    if isinstance(sym, int):
        if actual != sym:
            errors.append(f"{label}: dim {actual} != literal {sym} (spec {spec})")
    elif sym in resolved:
        if actual != resolved[sym]:
            errors.append(
                f"{label}: dim {sym}={actual} conflicts with "
                f"{sym}={resolved[sym]} bound earlier (spec {spec})"
            )
    else:
        resolved[sym] = actual


def _check_into(obj: Any, resolved: dict, where: str, errors: list, lead: tuple) -> None:
    specs = field_specs(type(obj))
    for f in dataclasses.fields(type(obj)):
        name = f.name
        value = getattr(obj, name)
        label = f"{where}.{name}"
        if name not in specs:
            if dataclasses.is_dataclass(value) and field_specs(type(value)):
                _check_into(value, resolved, label, errors, lead)
            continue
        spec = specs[name]
        try:
            dtype, shape = _leaf_info(value)
        except SpecError as e:
            errors.append(f"{label}: {e} (spec {spec})")
            continue
        if dtype != spec.dtype:
            errors.append(
                f"{label}: dtype {dtype}, spec says {spec}: "
                "a silent promotion or a constructor/remapper drift"
            )
        if len(shape) != len(lead) + len(spec.dims):
            axes = f" after {len(lead)} leading axes {lead}" if lead else ""
            errors.append(
                f"{label}: rank {len(shape)} shape {shape}, spec says {spec}{axes}"
            )
            continue
        for sym, actual in zip(lead + spec.dims, shape):
            _bind(sym, actual, resolved, label, spec, errors)


def dims_for(cfg, tasks=None) -> dict:
    """The canonical dim symbol table for a ``SimxConfig`` (+ optional
    ``TaskArrays``): W/G/L/NG from the config, T/J from the trace.  R (the
    reservation-queue cap) binds from the state's ``resq`` on first use."""
    dims = {
        "W": cfg.num_workers,
        "G": cfg.num_gms,
        "L": cfg.num_lms,
        "NG": cfg.num_groups,
    }
    if tasks is not None:
        dims["T"] = tasks.num_tasks
        dims["J"] = tasks.num_jobs
    return dims
