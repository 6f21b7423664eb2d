"""host_syncs_per_round: synchronising calls a round makes, counted by
torch's sync-debug mode over the traced stretch (megha's borrow check is one
a round).  Nothing to read off the card."""


def read(ctx):
    if not ctx.get("on_card") or "host_syncs" not in ctx:
        return None
    return ctx["host_syncs"] / ctx["stretch_rounds"]
