"""Framework-free pieces of ``repro.core`` the port needs, as its own
copies: metric records, the event loop and base scheduler, and the
event-driven schedulers (megha, and the sparrow, eagle and pigeon
baselines)."""
