"""Model-side helpers (the statistics side channel)."""
