from .base import Task
from .language_modeling import LanguageModelingTask
from .multilingual_speech_translation import (MultilingualSpeechTranslationTask,
                                              MultilingualSpeechTranslationWithTranscriptionTask)
from .multilingual_speech_translation_kd import MultilingualSpeechTranslationWithTranscriptionKDTask
from .multitask_speech_translation import SpeechTranslationMultiTask
from .speech_recognition import SpeechRecognitionTask
from .speech_recognition_context import ContextAwareSpeechRecognitionTask
from .speech_translation_ctc import SpeechTranslationCTCTask
from .speech_translation_ctc_kd import SpeechTranslationCTCWithKDTask
from .speech_translation_dualdecoding import SpeechTranslationDualDecodingTask
from .translation import TranslationTask

TASKS = {
    "speech_recognition": SpeechRecognitionTask,
    "speech_recognition_context": ContextAwareSpeechRecognitionTask,
    "speech_translation_with_transcription": SpeechTranslationCTCTask,
    "speech_translation_dualdecoding": SpeechTranslationDualDecodingTask,
    "speech_translation_multitask": SpeechTranslationMultiTask,
    "speech_translation_with_transcription_kd": SpeechTranslationCTCWithKDTask,
    "translation": TranslationTask,
    "language_modeling": LanguageModelingTask,
    "multilingual_speech_translation": MultilingualSpeechTranslationTask,
    "multilingual_speech_translation_with_transcr": MultilingualSpeechTranslationWithTranscriptionTask,
    "multilingual_speech_translation_with_transcr_kd": MultilingualSpeechTranslationWithTranscriptionKDTask,
}

__all__ = ["TASKS", "ContextAwareSpeechRecognitionTask", "LanguageModelingTask", "MultilingualSpeechTranslationTask", "MultilingualSpeechTranslationWithTranscriptionKDTask",
           "MultilingualSpeechTranslationWithTranscriptionTask", "SpeechRecognitionTask", "SpeechTranslationCTCTask",
           "SpeechTranslationCTCWithKDTask", "SpeechTranslationDualDecodingTask", "SpeechTranslationMultiTask", "Task",
           "TranslationTask"]
