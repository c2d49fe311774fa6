"""Cluster stage: comparison engines, dispatch, and the Bdb -> Cdb controller."""
