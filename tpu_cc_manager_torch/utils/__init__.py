"""Shared utilities of the port: card detection and polling."""
