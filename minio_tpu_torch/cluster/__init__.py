"""Cluster topology: drive endpoints (bare paths served by this node).

URL endpoints parse; the internode planes that serve a remote drive
come with slice 9b, and ``server/__main__.py`` refuses them until then.
"""
