"""Label tables, dataset scanners, host decode and batch preparation."""
