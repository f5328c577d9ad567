"""API keys / endpoints from environment variables (contract: reference
translators/keys.py — same variable names). A local ``.env`` file is parsed
if present (python-dotenv is not required)."""
from __future__ import annotations

import os


def _load_dotenv(path: str = '.env'):
    if not os.path.isfile(path):
        return
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith('#') or '=' not in line:
                    continue
                k, _, v = line.partition('=')
                os.environ.setdefault(k.strip(), v.strip().strip('"\''))
    except OSError:
        pass


_load_dotenv()

BAIDU_APP_ID = os.getenv('BAIDU_APP_ID', '')
BAIDU_SECRET_KEY = os.getenv('BAIDU_SECRET_KEY', '')
YOUDAO_APP_KEY = os.getenv('YOUDAO_APP_KEY', '')
YOUDAO_SECRET_KEY = os.getenv('YOUDAO_SECRET_KEY', '')
DEEPL_AUTH_KEY = os.getenv('DEEPL_AUTH_KEY', '')
OPENAI_API_KEY = os.getenv('OPENAI_API_KEY', '')
OPENAI_MODEL = os.getenv('OPENAI_MODEL', 'gpt-4o-mini')
OPENAI_HTTP_PROXY = os.getenv('OPENAI_HTTP_PROXY')
OPENAI_GLOSSARY_PATH = os.getenv('OPENAI_GLOSSARY_PATH',
                                 './dict/mit_glossary.txt')
OPENAI_API_BASE = os.getenv('OPENAI_API_BASE', 'https://api.openai.com/v1')
GROQ_API_KEY = os.getenv('GROQ_API_KEY', '')
GROQ_MODEL = os.getenv('GROQ_MODEL', 'mixtral-8x7b-32768')
SAKURA_API_BASE = os.getenv('SAKURA_API_BASE', 'http://127.0.0.1:8080/v1')
SAKURA_VERSION = os.getenv('SAKURA_VERSION', '0.9')
SAKURA_DICT_PATH = os.getenv('SAKURA_DICT_PATH', './dict/sakura_dict.txt')
CAIYUN_TOKEN = os.getenv('CAIYUN_TOKEN', '')
GEMINI_API_KEY = os.getenv('GEMINI_API_KEY', '')
GEMINI_MODEL = os.getenv('GEMINI_MODEL', 'gemini-1.5-flash-002')
DEEPSEEK_API_KEY = os.getenv('DEEPSEEK_API_KEY', '')
DEEPSEEK_API_BASE = os.getenv('DEEPSEEK_API_BASE', 'https://api.deepseek.com')
DEEPSEEK_MODEL = os.getenv('DEEPSEEK_MODEL', 'deepseek-chat')
TOGETHER_API_KEY = os.getenv('TOGETHER_API_KEY', '')
TOGETHER_VL_MODEL = os.getenv('TOGETHER_VL_MODEL',
                              'Qwen/Qwen2.5-VL-72B-Instruct')
CUSTOM_OPENAI_API_KEY = os.getenv('CUSTOM_OPENAI_API_KEY', 'ollama')
CUSTOM_OPENAI_API_BASE = os.getenv('CUSTOM_OPENAI_API_BASE',
                                   'http://localhost:11434/v1')
CUSTOM_OPENAI_MODEL = os.getenv('CUSTOM_OPENAI_MODEL', '')
CUSTOM_OPENAI_MODEL_CONF = os.getenv('CUSTOM_OPENAI_MODEL_CONF', '')
PAPAGO_CLIENT_ID = os.getenv('PAPAGO_CLIENT_ID', '')
PAPAGO_SECRET_KEY = os.getenv('PAPAGO_SECRET_KEY', '')
