"""Training: losses per preset, the train/eval steps, LR schedules, the
train state and its checkpoints, and the eval metrics."""
