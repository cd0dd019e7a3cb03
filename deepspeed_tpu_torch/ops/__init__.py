"""Operators: attention, dropout and the optimizers of the port."""
