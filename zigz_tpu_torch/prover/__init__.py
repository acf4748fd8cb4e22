"""The port's prover (protocol v1)."""
