"""Cross-cutting utilities of the port: logging, crash isolation, cron.

The port's copies of the JAX package's ``utils/gwlog``, ``gwutils`` and
``crontab``; ``opmon``, ``gwvar``, ``asyncjobs`` and ``binutil`` come
with the cluster components (ROADMAP.md queue 1, item 10).
"""
