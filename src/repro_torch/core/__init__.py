"""The port's own copies of ``repro.core``'s framework-free modules (link
fabric and scheduler, traffic plans, state controller, failure detection) and
of ``core/consistency.py`` on the port's tree utilities."""
