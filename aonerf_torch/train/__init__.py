"""Training: learning-rate schedule, Adam, the train step and the Trainer."""
