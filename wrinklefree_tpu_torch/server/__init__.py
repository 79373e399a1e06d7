"""The port's OpenAI- and llama.cpp-compatible HTTP server (standard library)."""

from .async_engine import AsyncEngine
from .http import InferenceServer, build_app, create_server
