"""One reader a per-layer metric, each in the file named after it."""
