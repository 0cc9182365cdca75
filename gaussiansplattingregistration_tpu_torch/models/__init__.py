"""Splat cloud, point cloud and camera models."""
