"""Training of the port: losses, optimizer and schedule, train steps, loop."""
