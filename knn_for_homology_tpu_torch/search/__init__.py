"""Flat exact search, index persistence and alignment rescoring."""
