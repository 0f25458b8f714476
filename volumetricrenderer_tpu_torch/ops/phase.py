"""Shared phase-function constant."""

PI = 3.1415926535  # the reference's truncated constant, kept for parity
