"""Framework seams of the port: device, flags, random streams."""
