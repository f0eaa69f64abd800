"""Serving constants (a copy of starvector_tpu/serve/constants.py; reference:
starvector/serve/constants.py)."""

CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15
CLIP_QUERY_LENGTH = 257
LOGDIR = "serve_logs"
WORKER_API_TIMEOUT = 100
ERROR_MSG = "**NETWORK ERROR. PLEASE REGENERATE OR REFRESH THIS PAGE.**"
