"""Run drivers that chain the models."""
