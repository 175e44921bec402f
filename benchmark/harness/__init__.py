"""The benchmark's harness: cells, traffic, timing, traces and checks."""
