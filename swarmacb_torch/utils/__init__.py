"""Utilities: the summary writer, whole-line prints."""

from .logging import JsonlWriter, make_writer, print_line

__all__ = ["JsonlWriter", "make_writer", "print_line"]
