"""Frozen bound arithmetic of the program's kernels: one file per kernel,
each giving the bytes and operations a launch needs at given shapes, and
`peaks`, the card's published rates."""
