"""Traffic kinds: each module drives one kind of traffic, named by the
``kind`` of a traffic file (``benchmark/traffic/<name>.json``)."""
