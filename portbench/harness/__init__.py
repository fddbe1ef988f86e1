"""The general parts of the benchmark: they hold no name of a cell, a
configuration or a metric, and find those in their own files by name."""
