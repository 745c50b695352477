from .base import Task
from .speech_recognition import SpeechRecognitionTask
from .speech_translation_ctc import SpeechTranslationCTCTask
from .translation import TranslationTask

TASKS = {
    "speech_recognition": SpeechRecognitionTask,
    "speech_translation_with_transcription": SpeechTranslationCTCTask,
    "translation": TranslationTask,
}

__all__ = ["TASKS", "SpeechRecognitionTask", "SpeechTranslationCTCTask", "Task", "TranslationTask"]
