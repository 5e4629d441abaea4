"""Small host utilities of the port."""
