"""Checks that hold two implementations of the port against each other."""
