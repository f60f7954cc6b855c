"""CPU tests of the benchmark (``gpu``-marked ones need a card)."""
