"""Framework-free pieces of ``repro.core`` the port needs, as its own
copies: metric records and the two shared constants/rules."""
