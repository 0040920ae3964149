"""Losses, the eval step and greedy generation."""
