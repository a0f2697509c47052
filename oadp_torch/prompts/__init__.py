"""Prompt builders for the frozen text classifiers."""
