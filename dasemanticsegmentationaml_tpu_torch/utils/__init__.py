"""Flag parsing and reference-named weight loading."""
