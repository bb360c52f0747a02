"""Cross-cutting utilities of the port: logging, crash isolation, cron,
published variables, ordered async jobs, the operation monitor and the
debug HTTP endpoint.

The port's copies of the JAX package's ``utils/gwlog``, ``gwutils``,
``crontab``, ``gwvar``, ``asyncjobs``, ``opmon`` and ``binutil``.
"""
