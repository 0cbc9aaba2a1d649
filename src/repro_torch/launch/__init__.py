"""Launch layer of the port: the PEPS query server (``launch.serve``)."""
