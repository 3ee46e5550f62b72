"""The benchmark's machinery: manifest, inputs, windows, traces, checks."""
