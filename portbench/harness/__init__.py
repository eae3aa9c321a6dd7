"""The benchmark harness: cells, inputs, windows, traces and the check."""
