"""Losses, multi-task weighting and the train step of the port."""
