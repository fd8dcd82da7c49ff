"""Metric functions of the port: numpy versions of the sklearn metrics the
configs name (`sklearn.metrics.*`), for hosts without sklearn."""
