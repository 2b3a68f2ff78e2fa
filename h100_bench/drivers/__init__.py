"""One module per traffic kind; a workload file names its driver."""
