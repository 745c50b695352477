from .base import Task
from .speech_recognition import SpeechRecognitionTask
from .speech_translation_ctc import SpeechTranslationCTCTask
from .speech_translation_dualdecoding import SpeechTranslationDualDecodingTask
from .translation import TranslationTask

TASKS = {
    "speech_recognition": SpeechRecognitionTask,
    "speech_translation_with_transcription": SpeechTranslationCTCTask,
    "speech_translation_dualdecoding": SpeechTranslationDualDecodingTask,
    "translation": TranslationTask,
}

__all__ = ["TASKS", "SpeechRecognitionTask", "SpeechTranslationCTCTask", "SpeechTranslationDualDecodingTask",
           "Task", "TranslationTask"]
