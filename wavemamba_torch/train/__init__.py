"""Training: schedules, the train step and training checkpoints. The
counterpart of `wavemamba_tpu/train/` (trainer, schedules, checkpoint)."""
