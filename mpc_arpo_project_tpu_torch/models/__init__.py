"""Dynamics models of the port: the Clohessy-Wiltshire relative-motion model."""
