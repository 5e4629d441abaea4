"""Manager-side types the port's agent needs."""
