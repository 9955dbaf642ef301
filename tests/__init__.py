"""Test suite (a regular package, so that ``tests.*`` imports resolve here
even when another installed package is also named ``tests``)."""
