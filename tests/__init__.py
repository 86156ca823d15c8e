"""Test suite (a package, so that ``tests.*`` resolves to this directory
ahead of any installed ``tests`` package)."""
