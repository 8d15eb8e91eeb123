"""Label tables, dataset scanners, host decode (native or PIL), the
decoded-sample cache, augmentation and batch preparation."""
