"""Command-line interface: offline rendering."""
