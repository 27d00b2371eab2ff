"""Host services over the torch engine."""
