"""Helpers of the port that hold no kernel."""
