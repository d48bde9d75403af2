"""Launch layer of the port: the host device mesh that serving places
shards on, and the train and serve launchers."""
