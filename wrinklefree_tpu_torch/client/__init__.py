from .client import AsyncInferenceClient, InferenceClient
