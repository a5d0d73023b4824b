"""Planner, execution context and dispatch."""
