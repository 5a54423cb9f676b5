"""Model configurations: the dataclasses and the archs the port serves."""
