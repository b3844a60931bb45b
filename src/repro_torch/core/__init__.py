"""Core math of the port: PRNG, sampling, WHS, SRS, errors, scan engine."""
