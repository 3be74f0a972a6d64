"""Training substrate: optimizer, schedules, train step, loop."""
