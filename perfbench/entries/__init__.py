"""The modules that run the port for a cell, one per kind of traffic (a traffic file's ``entry``)."""
