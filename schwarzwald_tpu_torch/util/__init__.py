"""Foundation utilities: errors, progress, journaling, terminal UI, units."""
