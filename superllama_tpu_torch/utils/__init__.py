"""Utilities of the port: the device profiler (``profiler``)."""
