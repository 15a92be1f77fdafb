"""Topology, pencils, arrays and the transpose engine of the port."""
