"""The benchmark's harness: set-up, the measured window, the trace's
reduction and the check of what the window produced."""
