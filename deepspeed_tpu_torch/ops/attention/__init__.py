"""Attention ops of the port: rotary, flash forward, paged decode."""
