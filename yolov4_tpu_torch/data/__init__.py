"""Eval-time data transforms."""
