"""Tests; a package so that `tests.oracle` and friends resolve here even
where another installed package is named `tests`."""
