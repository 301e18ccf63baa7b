"""Utilities: the summary writer."""

from .logging import JsonlWriter, make_writer

__all__ = ["JsonlWriter", "make_writer"]
