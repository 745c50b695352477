from .base import Task
from .speech_recognition import SpeechRecognitionTask
from .translation import TranslationTask

TASKS = {"speech_recognition": SpeechRecognitionTask, "translation": TranslationTask}

__all__ = ["TASKS", "SpeechRecognitionTask", "Task", "TranslationTask"]
