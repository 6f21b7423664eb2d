"""sync_wait_ms: host ms a round blocked on the card, from the program's own
spans: the summed duration of the spans it marks as host reads (Megha's
borrow check) inside the profiled stretch's rounds, over its rounds.  0
where the rounds make no read; nothing to read off the card or from a
program without the spans."""

from portbench.program_spans import record


def read(ctx):
    rec = record(ctx)
    if rec is None:
        return None
    ns = sum(s.end - s.start for s in rec.spans
             if s.read and s.round is not None and s.end is not None)
    return 1e-6 * ns / ctx["stretch_rounds"]
