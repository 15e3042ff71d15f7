"""Serving for the port: the plan server."""

from .engine import PlanServer

__all__ = ["PlanServer"]
