"""The port's device Merkle forest."""
