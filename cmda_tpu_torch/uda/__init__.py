"""Unsupervised domain adaptation: the DACS trainer and its loss pieces."""
