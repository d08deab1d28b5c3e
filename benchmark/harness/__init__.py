"""The benchmark's harness: the cell's files, the window's drive, the trace, the check."""
