"""Observability of the port: roofline cost models and the card's
measured peaks (``roofline``)."""
