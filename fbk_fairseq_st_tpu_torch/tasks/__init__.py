from .base import Task
from .speech_recognition import SpeechRecognitionTask

TASKS = {"speech_recognition": SpeechRecognitionTask}

__all__ = ["TASKS", "SpeechRecognitionTask", "Task"]
