"""The port's web applications (counterpart of ``helicon_tpu/webApps``).

The compute layers import without shiny; the ``app.py`` UIs need the
optional ``shiny`` extra and run every computation on their package's
``DEVICE``.
"""
