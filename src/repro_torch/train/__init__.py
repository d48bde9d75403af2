"""Training on one device: AdamW, the train step, compression,
checkpoint/restart and the fault-tolerant loop."""
