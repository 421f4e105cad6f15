"""The serving layer of the port: the stream server and its socket front
door."""
