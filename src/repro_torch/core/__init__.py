"""Planner, engine, schedules and quantization of the port."""
