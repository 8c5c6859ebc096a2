"""Atomic, asynchronous checkpoints of torch parameter and optimizer
trees."""
