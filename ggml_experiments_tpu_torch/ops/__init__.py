"""Operators: linear, GRU cell, sampling and the persistent fused decode."""
