"""Command-line entry points of the torch port."""
