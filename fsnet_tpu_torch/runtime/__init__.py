"""Runtime of the port: the eval step."""
