"""Host block operators and the nested-dissection direct solver."""
