"""One reader a metric: ``metrics/<name>.py`` defines ``read(run)``, which
returns the metric's number from a :class:`perfbench.harness.Run`, or
None when the run holds nothing for it to read."""
