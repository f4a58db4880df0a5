"""Training: optimizer, schedules and the training loop."""
