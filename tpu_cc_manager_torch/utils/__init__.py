"""Shared utilities of the port: card detection, polling and local ranks."""
