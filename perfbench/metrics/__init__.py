"""Metric readers, one file a metric (``<name>.py``), and what they share."""
