"""Executor and planner of the port: the planner modules (optimizer, cost,
ranges, codecache, prune) and the device-side executor modules."""
