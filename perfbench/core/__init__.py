"""The harness: traffic, the program's set-up, the window, the trace and
the comparison that decides ``correct``."""
