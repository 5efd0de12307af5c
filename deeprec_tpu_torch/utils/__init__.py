"""Host runtime: the native key resolver binding."""
