"""The decoder-only dense transformer and its facade."""
