"""The harness: the parts every cell shares."""
