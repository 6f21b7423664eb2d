"""Training (port of ``repro/train``): AdamW, the train step and loop, and
checkpoint/restart."""
