"""The port's web applications (counterpart of ``helicon_tpu/webApps``).

Only the compute layers are ported; the Shiny UIs (``app.py``) are not
(ROADMAP A11).
"""
